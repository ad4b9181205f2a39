"""The model zoo (PyTorch port of ``repro.models``): shared substrate
(:mod:`.common`), GQA attention (:mod:`.attention`), the dense stack
(:mod:`.transformer`) and the :class:`~.model.Model` facade.  The MoE, SSM,
recurrent and enc-dec / VLM pieces come with later slices (ROADMAP A11)."""
