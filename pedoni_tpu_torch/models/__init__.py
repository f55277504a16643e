"""Grid-backend model: state, step configuration and the grid step."""
