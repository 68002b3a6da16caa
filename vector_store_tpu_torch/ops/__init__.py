"""Device compute ops: quantization, distances, top-k, and the two scan
kernels (fused_scan: flat scan; ivf.grouped_scan: IVF cluster scan) with
their build/bind layer (kernels)."""
