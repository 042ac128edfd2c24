"""Support-cache and query-path entry points."""
