"""AP tables and drawings (weakcube_tpu/vis/)."""
