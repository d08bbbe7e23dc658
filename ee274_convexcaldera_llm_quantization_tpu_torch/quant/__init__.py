"""Block quantizers (the uniform, NF and affine-outlier families and the
E8P lattice) behind ``CalderaParams``, and the SCL baselines (scalar
uniform, Lloyd-Max, K-means VQ)."""
