"""Step functions, the trainer, the token-serving loop, the production mesh
and the dry run (PyTorch port of :mod:`repro.launch`)."""
