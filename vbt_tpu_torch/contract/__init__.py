"""The tracking dataframe contract (schema, filename grammar) and the
ground-truth parsers."""
