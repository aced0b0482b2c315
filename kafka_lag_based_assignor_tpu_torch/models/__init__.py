"""Host-side greedy oracle (the `host` solver)."""
