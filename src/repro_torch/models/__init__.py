"""Model blocks of the PyTorch port: the MoE layer (``moe``), its SAM
programs (``moe_blocks``) and the pruned transformer on the SAM engine
(``pruned_transformer``), with the few shared helpers they need
(``common``)."""
