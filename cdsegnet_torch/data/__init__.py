"""Host-side data pipeline: transforms, datasets and static-bucket collation."""
