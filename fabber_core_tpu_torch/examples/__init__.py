"""Example user model plugins for fabber_core_tpu_torch."""
