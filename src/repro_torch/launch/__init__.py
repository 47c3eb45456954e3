"""Command-line entry points of the port (``python -m
repro_torch.launch.serve``, ``.train``, ``.dryrun``, ``.roofline``), the
pod meshes (``launch.mesh``), the dry run's abstract inputs
(``launch.specs``) and analytic model (``launch.analytic``), and the
roofline terms (``launch.roofline``).  Importing the package starts no
process group."""

from . import roofline  # noqa: F401
