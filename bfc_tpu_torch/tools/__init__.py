"""Tools of the port: hash2cnt (a -d dump decoded), errstat (SAM-scored
correction quality) and human_scale (the capacity rehearsal)."""
