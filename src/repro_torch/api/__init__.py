"""Public API of the port: the fleet engine (`engine`)."""
