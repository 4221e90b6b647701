"""Attention ops and the flash-attention kernels."""
