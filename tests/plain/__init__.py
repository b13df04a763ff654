"""Plain references the port is held against in the tests."""
