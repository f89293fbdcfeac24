"""Test data for the port: streams made to exercise its decoders
(corrupt), shared by the tests and chip_smoke.py."""
