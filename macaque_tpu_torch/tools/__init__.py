"""Tools of the port: the synthetic scene generator, the overlay render
and the 3D tracking validation."""
