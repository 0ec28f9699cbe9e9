"""Drivers of the port: the real-model serving entry point
(``launch.serve``) and the trainer (``launch.train``)."""
