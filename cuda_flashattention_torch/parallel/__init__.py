"""The distributed layer of the port: mesh and streams (mesh), ring
attention and sharded decode (ring), Ulysses (ulysses), GPipe (pipeline)
and the device-initiated ring (device_ring)."""
