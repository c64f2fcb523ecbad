"""Launchers of the port: the step functions (``steps``) and the training and
serving entry points (``train``, ``serve``)."""
