"""Segmentation of the multi-model step (the external-mask mode)."""
