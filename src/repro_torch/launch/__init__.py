"""Launch helpers of the port (the mesh and its process launcher)."""
