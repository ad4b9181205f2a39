"""Model configuration records (PyTorch port of the config part of
``repro.models``; the layers come with the model-zoo slice, ROADMAP A11)."""
