"""Scene data model, asset loaders, and the NumPy BVH builder."""
