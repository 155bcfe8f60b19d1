"""Interactive SQL console (reference: cli/console.cc + evql.cc).

Runs queries against a local embedded runtime or a remote HTTP server
and renders ASCII result tables like the reference's console codec
(reference: server/sql/codec/ascii_codec.cc)."""

from __future__ import annotations

import argparse
import json
import sys
import urllib.request
from typing import List, Optional


def render_ascii_table(columns: List[str], rows: List[List[str]]) -> str:
    # reference: ASCIICodec table rendering — +--+ borders, padded cells
    widths = [len(c) for c in columns]
    for row in rows:
        for i, cell in enumerate(row):
            widths[i] = max(widths[i], len(cell))

    def sep():
        return "+" + "+".join("-" * (w + 2) for w in widths) + "+"

    def fmt_row(cells):
        return (
            "|"
            + "|".join(
                " " + c.ljust(w) + " " for c, w in zip(cells, widths)
            )
            + "|"
        )

    out = [sep(), fmt_row(columns), sep()]
    for row in rows:
        out.append(fmt_row(row))
    out.append(sep())
    return "\n".join(out)


def split_statements(text: str):
    """Split a script on top-level ';' (quote/comment aware) so each
    statement builds against the tables created by the previous ones —
    the same effect as typing them interactively."""
    out = []
    buf = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c in ("'", '"', "`"):
            q = c
            buf.append(c)
            i += 1
            while i < n:
                buf.append(text[i])
                if text[i] == "\\" and q != "`" and i + 1 < n:
                    buf.append(text[i + 1])
                    i += 2
                    continue
                if text[i] == q:
                    i += 1
                    break
                i += 1
            continue
        if c == "-" and text[i : i + 2] == "--":
            while i < n and text[i] != "\n":
                buf.append(text[i])
                i += 1
            continue
        if c == "/" and text[i : i + 2] == "/*":
            end = text.find("*/", i + 2)
            end = n if end < 0 else end + 2
            buf.append(text[i:end])
            i = end
            continue
        if c == ";":
            buf.append(c)
            stmt = "".join(buf).strip()
            if stmt and stmt != ";":
                out.append(stmt)
            buf = []
            i += 1
            continue
        buf.append(c)
        i += 1
    tail = "".join(buf).strip()
    if tail:
        out.append(tail if tail.endswith(";") else tail + ";")
    return out


class LocalBackend:
    def __init__(self, device="cuda"):
        from eventql_tpu_torch.db.table_service import TableService
        from eventql_tpu_torch.exec.runtime import Runtime

        self.runtime = Runtime(device=device)
        self.tables = TableService()

    def execute(self, query: str):
        txn = self.runtime.new_transaction(self.tables)
        plan = self.runtime.build_query_plan(txn, query)
        return [plan.execute(i) for i in range(plan.num_queries)]


class HTTPBackend:
    def __init__(self, host: str, port: int, auth_token: str = "",
                 user: str = "", password: str = ""):
        self.url = f"http://{host}:{port}/api/v1/sql"
        self.headers = {"Content-Type": "application/json"}
        # reference: http_auth.cc — Token / Basic authorization headers
        if auth_token:
            self.headers["Authorization"] = f"Token {auth_token}"
        elif user:
            import base64

            cred = base64.b64encode(f"{user}:{password}".encode()).decode()
            self.headers["Authorization"] = f"Basic {cred}"

    def execute(self, query: str):
        from eventql_tpu_torch.exec.result import ResultList

        req = urllib.request.Request(
            self.url,
            data=json.dumps({"query": query}).encode(),
            headers=self.headers,
        )
        try:
            with urllib.request.urlopen(req) as resp:
                payload = json.loads(resp.read())
        except urllib.error.HTTPError as e:
            payload = json.loads(e.read())
        if "error" in payload:
            from eventql_tpu_torch.core.errors import RuntimeError_

            raise RuntimeError_(payload["error"])
        return [
            ResultList(r["columns"], r["rows"]) for r in payload["results"]
        ]


def main(argv=None):
    # flag set mirrors the reference binary (evql.cc:67-229)
    ap = argparse.ArgumentParser(prog="evql", description="eventql_tpu_torch SQL console")
    ap.add_argument("-h2", "--host", default=None, help="server host")
    ap.add_argument("-p", "--port", type=int, default=9175)
    ap.add_argument("-e", "--exec", dest="execute", default=None, help="run one query and exit")
    ap.add_argument("-f", "--file", default=None, help="execute the queries in this file")
    ap.add_argument("-l", "--lang", default="sql", choices=["sql"], help="query language")
    ap.add_argument("-D", "--database", default="", help="select database")
    ap.add_argument("-u", "--user", default="")
    ap.add_argument("--password", default="")
    ap.add_argument("--auth_token", default="")
    ap.add_argument("-B", "--batch", action="store_true", help="tab-separated output, no table borders")
    ap.add_argument("-q", "--quiet", action="store_true", help="suppress row-count footers")
    ap.add_argument("--output_file", default=None, help="write results to this file")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the embedded engine's routes run (without --host)")
    args = ap.parse_args(argv)

    backend = (
        HTTPBackend(
            args.host, args.port,
            auth_token=args.auth_token,
            user=args.user,
            password=args.password,
        )
        if args.host
        else LocalBackend(args.device)
    )

    out_fh = open(args.output_file, "w") if args.output_file else sys.stdout

    def emit(text):
        out_fh.write(text + "\n")

    def run_one(q: str) -> int:
        from eventql_tpu_torch.core.errors import SQLError

        try:
            for result in backend.execute(q):
                if args.batch:
                    emit("\t".join(result.columns))
                    for row in result.rows:
                        emit("\t".join(row))
                else:
                    emit(render_ascii_table(result.columns, result.rows))
                    if not args.quiet:
                        emit(f"{result.num_rows} row(s)")
        except SQLError as e:
            print(f"ERROR: {e.message}", file=sys.stderr)
            return 1
        return 0

    if args.database:
        run_one(f"use {args.database};")

    if args.file:
        rc = 0
        with open(args.file) as f:
            for stmt in split_statements(f.read()):
                rc = run_one(stmt)
                if rc:
                    break
        if args.output_file:
            out_fh.close()
        sys.exit(rc)

    if args.execute:
        rc = run_one(args.execute)
        if args.output_file:
            out_fh.close()
        sys.exit(rc)

    try:
        import readline  # noqa: F401 — line editing
    except ImportError:
        pass

    print("eventql_tpu_torch console — end statements with ';', ctrl-d to exit")
    buf = ""
    while True:
        try:
            prompt = "evql> " if not buf else "   -> "
            line = input(prompt)
        except EOFError:
            print()
            break
        except KeyboardInterrupt:
            buf = ""
            print()
            continue
        buf += line + "\n"
        if line.rstrip().endswith(";"):
            run_one(buf)
            buf = ""


if __name__ == "__main__":
    main()
