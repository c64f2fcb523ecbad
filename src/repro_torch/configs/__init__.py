"""Scheduler configurations of the PyTorch port."""
