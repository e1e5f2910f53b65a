"""Device selection and image output."""
