"""Device selection, image output, checkpoint / resume and metrics."""
