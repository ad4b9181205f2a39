"""Step functions, the trainer and the token-serving loop (PyTorch port of
:mod:`repro.launch`; the dry run and the mesh helpers are not ported)."""
