"""Per-layer metric `bn_ms_per_step.train`: the summed device time of
BatchNorm's training kernels (weakcube_tpu_torch/csrc/batch_norm.cu, whose
kernel names all hold `bn_train_`) in the traced window, per training step,
in ms. None where the trace holds no such kernel (a program without them)."""
STEM = "bn_train_"


def read(layer: dict):
    if layer.get("kind") != "train" or "trace" not in layer or not layer.get("steps"):
        return None
    seconds = layer["trace"].kernel_seconds(STEM)
    return 1e3 * seconds / layer["steps"] if seconds > 0 else None
