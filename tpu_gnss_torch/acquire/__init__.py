"""Folded acquisition (the fused-kernel engine) and the 1-bit mix."""
