"""Resilience: the in-step non-finite guard (the JAX package's
``resilience/guards.py``)."""
