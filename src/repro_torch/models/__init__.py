"""Models of the PyTorch port: the language-model stack (``model``, with
``attention``, ``mla``, ``mamba2``, ``xlstm`` and ``ssm_common``), the
MoE layer (``moe``), its SAM programs (``moe_blocks``) and the pruned
transformer on the SAM engine (``pruned_transformer``), with the shared
helpers (``common``)."""
