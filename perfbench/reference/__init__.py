"""The plain PyTorch reference that decides ``correct``: DPVO's frame loop,
networks, geometry and local BA, with no part of the program."""
