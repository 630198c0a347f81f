"""Fields of the port: the CP/VM fields (models/cp.py), Instant-NGP,
D-NeRF, TensoRF and the SDF network, their MLP towers and parameter trees."""
