"""Host tools of the port: hash2cnt (a -d dump decoded) and errstat
(SAM-scored correction quality)."""
