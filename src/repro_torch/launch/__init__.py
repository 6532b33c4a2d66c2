"""Launchers of the port: the serving engine and its CLI, the trainer,
the meshes (``mesh``) and the step builders (``steps``)."""
