"""Parallel building blocks of the port: the attention kernels
(:mod:`.flash_attention`), the stacked-stage layout of pipelines
(:mod:`.pipeline`), the dense Switch-MoE reference (:mod:`.moe`) and
gradient accumulation over microbatches (:mod:`.microbatch`).  The
multi-device engines wait for ROADMAP A11.2."""
