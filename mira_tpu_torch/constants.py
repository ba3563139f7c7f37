"""Global protocol constants (reference src/constants.rs).

Copied from mira_tpu/constants.py; the port imports nothing of mira_tpu.
"""

MAX_BITS = 255
# hashes are truncated to this many bits before field interpretation
NUM_HASH_BITS = 250
NUM_CHALLENGE_BITS = 128
