"""Step functions and the token-serving loop (PyTorch port of the
serving part of :mod:`repro.launch`; the trainer, the dry-run and the mesh
helpers come with later slices, ROADMAP A11)."""
