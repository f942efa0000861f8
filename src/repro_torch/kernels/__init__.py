"""Hand-written Hopper GEMV kernels, their planner and the dispatcher."""
