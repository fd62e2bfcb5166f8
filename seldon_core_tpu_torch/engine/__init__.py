"""The engine: prediction service and its HTTP front."""
