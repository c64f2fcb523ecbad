"""Launchers of the port: step builders (``steps``) and the serving entry point
(``serve``)."""
