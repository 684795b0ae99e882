"""Model zoo, forward and serving path of the MoE family (port of
``repro.models``): ``layers``, ``lm_common``, ``sp_decode``, the decode
cache of ``transformer``, ``moe_transformer`` and the family dispatcher
``model_zoo``.

Unlike the reference's, this ``__init__`` imports no submodule:
``repro_torch.moe.layer`` imports ``models.layers`` and
``models.moe_transformer`` imports ``moe.layer``, so an eager import of
``model_zoo`` here would close a cycle for whichever is imported first.
Import ``from repro_torch.models import model_zoo``.
"""
