"""Launch layer of the port: the mesh (``mesh``), the train / serve / prefill
steps (``steps``) and the training and serving entry points (``train``,
``serve``)."""
from .mesh import make_host_mesh, make_production_mesh
from .steps import make_prefill_step, make_serve_step, make_train_step

__all__ = ["make_host_mesh", "make_production_mesh", "make_prefill_step",
           "make_serve_step", "make_train_step"]
