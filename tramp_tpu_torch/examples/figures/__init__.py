"""The figure protocols: sparse regression, sparse phase retrieval, the
phase diagram, the SE grid's scaling and the EP wall-time benchmark."""
