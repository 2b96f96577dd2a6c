"""Single-device fused optimization step (fused_step.py)."""
