"""Archive converters between the reference's Serialbox "Binary" archives
and the snapshot files the port reads (`.npz`, `.h5`): `h52serialbox` and
`serialbox2h5`, numpy only."""
