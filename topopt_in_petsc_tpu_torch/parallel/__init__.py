"""The single-device fused optimization step (fused_step.py) and the
multi-device engine of `-mesh_shape` (spmd_driver.py and the modules it
runs on)."""
