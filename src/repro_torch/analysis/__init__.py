"""Static checks of the port's kernel launches: ``analysis.contracts``."""
