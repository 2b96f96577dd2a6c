"""Elements and the elasticity model."""
