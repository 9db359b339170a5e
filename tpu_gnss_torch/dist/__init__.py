"""Sharded acquisition and tracking over a device mesh, in one process or several."""
