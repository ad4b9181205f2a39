"""Roofline analysis of the port's dry-run cells and simulator traces."""
