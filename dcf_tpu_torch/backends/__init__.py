"""Evaluation backends of the port."""
