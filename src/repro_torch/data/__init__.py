"""Instance generators of the port."""
