"""Compatibility package: absorbed into :mod:`..sharded`.  ``parallel.mesh``
re-exports the topic-axis API from :mod:`..sharded.topics`."""
