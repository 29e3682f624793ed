"""Model configurations of the port (torch dtypes)."""
