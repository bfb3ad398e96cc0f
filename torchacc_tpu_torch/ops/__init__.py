"""Ops of the port: the paged-attention kernel (``ops.paged_attention``),
the flash-attention kernels (``ops.flash_attention``) behind the
``ops.attn`` dispatcher, their plain versions (``ops.attention``), and
the fused linear + cross-entropy head (``ops.fused``)."""
