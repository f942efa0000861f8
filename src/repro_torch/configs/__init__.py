"""Model configurations of the port (olmo-1b in this slice)."""
