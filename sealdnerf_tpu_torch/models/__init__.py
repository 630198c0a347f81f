"""Fields of the port: the static CP/VM field (models/cp.py) and its MLP
towers."""
