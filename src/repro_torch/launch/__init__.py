"""Launch helpers: meshes (``mesh``) and the training CLI (``train``)."""
