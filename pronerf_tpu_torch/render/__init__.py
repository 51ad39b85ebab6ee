"""Frame rendering and the serving entry points."""
