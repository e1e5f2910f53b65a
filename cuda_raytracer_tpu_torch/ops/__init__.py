"""Numeric primitives and ray operations on torch tensors."""
