"""The metrics plane: device counters (device.py) and the host fold (host.py)."""
