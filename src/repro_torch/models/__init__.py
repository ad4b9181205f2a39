"""The model zoo (PyTorch port of ``repro.models``): shared substrate
(:mod:`.common`), GQA attention (:mod:`.attention`), the MoE, SSM and
RG-LRU blocks (:mod:`.moe`, :mod:`.ssm`, :mod:`.recurrent`), the
modality frontend stubs (:mod:`.frontends`), the decoder-only and
encoder-decoder stacks (:mod:`.transformer`) and the
:class:`~.model.Model` facade."""
