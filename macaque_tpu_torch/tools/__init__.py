"""Tools of the port: the synthetic scene generator."""
