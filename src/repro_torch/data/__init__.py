"""Input pipeline of the port (a copy of ``repro.data``)."""
