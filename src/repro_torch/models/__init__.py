"""Model configs, the dense transformer and the parameter bridge."""
