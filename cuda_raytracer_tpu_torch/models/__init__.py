"""Scene data model, asset loaders, the BVH builder and the cluster cut."""
