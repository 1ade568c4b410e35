"""Distributed-optimisation helpers of the port (gradient compression).
The sharding rules and the device mesh are not ported yet."""
