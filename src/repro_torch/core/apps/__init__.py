"""Applications built on the F-IVM engine."""
