"""Parallel building blocks of the port: the attention kernels
(:mod:`.flash_attention`), the stacked-stage layout of pipelines
(:mod:`.pipeline`), the dense Switch-MoE reference (:mod:`.moe`) and
gradient accumulation over microbatches (:mod:`.microbatch`), and the
multi-rank engines: collectives over a mesh of ranks (:mod:`.collective`),
layouts (:mod:`.sharded`, :mod:`.tp`), ring and Ulysses attention
(:mod:`.ring_attention`, :mod:`.ulysses`), the expert-parallel
``switch_moe`` (:mod:`.moe`) and the pipeline schedules
(:mod:`.pipeline`)."""
