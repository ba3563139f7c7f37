"""The plain step functions of the poseidon-k17 configuration: the primary
side hashes z with Poseidon (T=3, RATE=2, R_F=4, R_P=3) repeat_count + 1
times a step; the secondary side's trivial circuit returns z unchanged."""

from reference import poseidon


def z_after(cfg: dict, moduli, side: str, z0, steps: int):
    """A side's z after `steps` applications of its step function."""
    s = cfg[side]
    if s["circuit"] == "trivial":
        return list(z0)
    if s["circuit"] != "poseidon":
        raise ValueError(f"no plain step function for {s['circuit']!r}")
    p = moduli[0 if side == "primary" else 1]
    times = (s["repeat_count"] + 1) * steps
    return [poseidon.hash_chain(z0[0], p, s["poseidon"], times)]
