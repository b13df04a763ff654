"""Device policy and stage timing."""
