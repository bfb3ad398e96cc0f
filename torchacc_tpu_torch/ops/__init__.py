"""Ops of the port: the paged-attention kernel and its plain version
(``torchacc_tpu_torch.ops.paged_attention``)."""
