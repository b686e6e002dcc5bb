"""Native runtime components (C, built on demand, loaded via ctypes)."""
