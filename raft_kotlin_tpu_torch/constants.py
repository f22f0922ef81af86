"""Role and round-state encodings (SEMANTICS.md §2, §5) — the port's own copy.

These values are part of the trace format the tests compare bit for bit
against the JAX package. Roles mirror the reference's `enum class State`
ordinal order (RaftServer.kt:24-26).
"""

FOLLOWER, CANDIDATE, LEADER = 0, 1, 2
IDLE, BACKOFF, ACTIVE = 0, 1, 2
