"""Data: synthetic scenes, the Omni3D dataset layer and the pseudo-GT
generators (weakcube_tpu/data)."""
