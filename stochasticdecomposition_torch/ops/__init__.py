"""Numerical kernels: simplex, QP, basis inverse, the triple masked argmax."""
