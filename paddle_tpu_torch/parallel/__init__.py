"""Attention kernels of the port (see :mod:`.flash_attention`)."""
