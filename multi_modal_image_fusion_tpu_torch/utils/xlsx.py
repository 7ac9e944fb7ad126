"""Minimal xlsx writer (pure python, zipfile + SpreadsheetML) in place of the
reference's openpyxl dependency for the eval CLI's metric workbooks
(reference eval.py:78-97, 268-361). Supports multiple sheets and
column-oriented writes with mixed str/number cells (inline strings, no
shared-string table). The port's own copy of multi_modal_image_fusion_tpu
utils/xlsx.py, writing the same XML."""

import zipfile
from xml.sax.saxutils import escape


def _col_letter(idx):
    """0-based column index -> A, B, ..., Z, AA, ..."""
    s = ""
    idx += 1
    while idx:
        idx, rem = divmod(idx - 1, 26)
        s = chr(ord("A") + rem) + s
    return s


class Workbook:
    def __init__(self):
        self._sheets = {}      # name -> {(row, col): value}
        self._order = []

    def sheet(self, name):
        if name not in self._sheets:
            self._sheets[name] = {}
            self._order.append(name)
        return self._sheets[name]

    def set_cell(self, sheet_name, row, col, value):
        self.sheet(sheet_name)[(row, col)] = value

    def set_column(self, sheet_name, col, values, start_row=0):
        """Write a list of values down a column (the reference eval.py
        write_excel contract)."""
        for i, v in enumerate(values):
            self.set_cell(sheet_name, start_row + i, col, v)

    # -- serialization ----------------------------------------------------
    def _sheet_xml(self, cells):
        rows = {}
        for (r, c), v in cells.items():
            rows.setdefault(r, {})[c] = v
        out = ['<?xml version="1.0" encoding="UTF-8" standalone="yes"?>',
               '<worksheet xmlns="http://schemas.openxmlformats.org/'
               'spreadsheetml/2006/main"><sheetData>']
        for r in sorted(rows):
            out.append(f'<row r="{r + 1}">')
            for c in sorted(rows[r]):
                v = rows[r][c]
                ref = f"{_col_letter(c)}{r + 1}"
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    out.append(f'<c r="{ref}"><v>{v!r}</v></c>')
                else:
                    out.append(
                        f'<c r="{ref}" t="inlineStr"><is><t>'
                        f"{escape(str(v))}</t></is></c>")
            out.append("</row>")
        out.append("</sheetData></worksheet>")
        return "".join(out)

    def save(self, path):
        names = self._order or ["Sheet1"]
        if not self._sheets:
            self._sheets["Sheet1"] = {}

        content_types = (
            '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            '<Types xmlns="http://schemas.openxmlformats.org/package/2006/'
            'content-types">'
            '<Default Extension="rels" ContentType="application/vnd.'
            'openxmlformats-package.relationships+xml"/>'
            '<Default Extension="xml" ContentType="application/xml"/>'
            '<Override PartName="/xl/workbook.xml" ContentType="application/'
            'vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml'
            '"/>' + "".join(
                f'<Override PartName="/xl/worksheets/sheet{i + 1}.xml" '
                'ContentType="application/vnd.openxmlformats-officedocument'
                '.spreadsheetml.worksheet+xml"/>'
                for i in range(len(names))) + "</Types>")

        rels = (
            '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            '<Relationships xmlns="http://schemas.openxmlformats.org/'
            'package/2006/relationships">'
            '<Relationship Id="rId1" Type="http://schemas.openxmlformats.'
            'org/officeDocument/2006/relationships/officeDocument" '
            'Target="xl/workbook.xml"/></Relationships>')

        sheets_xml = "".join(
            f'<sheet name="{escape(n)}" sheetId="{i + 1}" r:id="rId{i + 1}"'
            "/>" for i, n in enumerate(names))
        workbook = (
            '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            '<workbook xmlns="http://schemas.openxmlformats.org/'
            'spreadsheetml/2006/main" xmlns:r="http://schemas.'
            'openxmlformats.org/officeDocument/2006/relationships">'
            f"<sheets>{sheets_xml}</sheets></workbook>")

        wb_rels = (
            '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            '<Relationships xmlns="http://schemas.openxmlformats.org/'
            'package/2006/relationships">' + "".join(
                f'<Relationship Id="rId{i + 1}" Type="http://schemas.'
                'openxmlformats.org/officeDocument/2006/relationships/'
                f'worksheet" Target="worksheets/sheet{i + 1}.xml"/>'
                for i in range(len(names))) + "</Relationships>")

        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
            z.writestr("[Content_Types].xml", content_types)
            z.writestr("_rels/.rels", rels)
            z.writestr("xl/workbook.xml", workbook)
            z.writestr("xl/_rels/workbook.xml.rels", wb_rels)
            for i, n in enumerate(names):
                z.writestr(f"xl/worksheets/sheet{i + 1}.xml",
                           self._sheet_xml(self._sheets[n]))
