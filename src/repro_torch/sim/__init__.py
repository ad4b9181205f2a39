"""Trace synthesis, staging, engines and the study planner (PyTorch port
of ``repro.sim``)."""
