"""Signatures and coherence mechanisms (PyTorch port of ``repro.core``)."""
