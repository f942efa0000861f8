"""Dense decoder layers and the LM forward."""
