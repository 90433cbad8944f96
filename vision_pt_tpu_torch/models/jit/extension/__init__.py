"""JiT architecture variants (port of ``vision_pt_tpu/models/jit/extension``):
PoPE, U-JiT, Cross-JiT, internal guidance (IG, LoIG) and TREAD routing."""
