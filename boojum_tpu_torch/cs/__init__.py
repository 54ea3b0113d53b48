"""Constraint-system front end: geometry, gates, synthesis and assembly."""
