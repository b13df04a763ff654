"""The tracking dataframe contract (schema, filename grammar)."""
