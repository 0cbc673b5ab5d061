"""Fleet routing helpers (the affinity keys; the router itself is not ported)."""
