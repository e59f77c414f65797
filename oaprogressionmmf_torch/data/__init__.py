"""Host data layer of the port: the OAI index, the fold provider (both
pandas, imported inside their functions), the dataset and the loader."""
