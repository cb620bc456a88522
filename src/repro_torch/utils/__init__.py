"""Pytree, dtype-conversion and device helpers shared by the port."""
