"""Block quantizers (the uniform, NF and affine-outlier families and the
E8P lattice) behind ``CalderaParams``."""
