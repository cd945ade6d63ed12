"""The systems under test, one file an architecture (`<arch>.py`, found by
`registry.program`): each builds the port's `Detector` from a configuration
of its architecture."""
