"""Design filters and MMA."""
