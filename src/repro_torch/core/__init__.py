"""Core solver of the port: layout, engine, ARD sweeps, session front end."""
