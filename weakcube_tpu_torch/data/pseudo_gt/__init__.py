"""Foundation models that make pseudo ground truth (weakcube_tpu/data/pseudo_gt)."""
