"""Numerical substrate: dynamic fixed-point formats and their controllers."""
