"""Partition specs of the pod path (the port of ``repro/sharding``)."""
